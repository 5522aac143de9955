"""Video VQVAE: a 3D-conv tokenizer for clips (port of
``unidisc_tpu/tokenizers/video.py``).

A clip (B, T, H, W, 3) in [-1, 1] encodes to ids (B, T/d * H/d * W/d),
time-major, through a VideoGPT-style 3D-conv encoder (one (2, 2, 2)
stride per level) and one L2-normalised codebook; the decoder upsamples
each level by nearest-neighbour doubling of every axis before its conv.
The modules run in NCDHW with (O, I, D, H, W) kernels; submodules carry
the flax names (``conv_in``, ``res_{i}_{j}``, ``down_{i}``, ``mid``,
``up_{i}``, ``norm_out``, ``conv_out``; ``shortcut`` in a block that
changes width), so ``vqgan.state_dict_from_jax`` carries the flax tree
over (DHWIO -> OIDHW).

Numerics follow the flax module in fp32: GroupNorm of 8 groups, eps 1e-6
(flax takes the variance as E[x^2] - E[x]^2, torch as E[(x - E[x])^2]);
the stride-2 4^3 convs pad 1 on every side, as flax's ``padding=1`` does;
``quantize`` is the argmax of z.c - |c|^2 / 2 over the codebook (the first
index of a tie). An id outside the codebook raises (``jnp.take`` fills
NaN).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.tokenizers.magvit import check_ids
from unidisc_tpu_torch.tokenizers.vqgan import (_truncated_normal_,
                                                state_dict_from_jax)


@dataclass(frozen=True)
class VideoVQConfig:
    codebook_size: int = 2048      # VideoGPT-scale default
    codebook_dim: int = 256
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2)   # one (2, 2, 2) stride a level
    num_res_blocks: int = 1
    l2_norm_codes: bool = True

    @property
    def downsample(self) -> int:
        """Spatial (and temporal) downsample factor: 2 a level."""
        return 2 ** len(self.ch_mult)


class GroupNorm8(nn.Module):
    """8-group GroupNorm, eps 1e-6, then SiLU (every norm here is followed
    by one)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(F.group_norm(x, 8, self.weight, self.bias, 1e-6))


def conv3d(cin: int, cout: int, k: int, stride: int = 1,
           padding: int = 0) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, stride=stride, padding=padding)


class ResBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm8(cin)
        self.conv1 = conv3d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm8(cout)
        self.conv2 = conv3d(cout, cout, 3, padding=1)
        if cin != cout:
            self.shortcut = conv3d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class VideoEncoder(nn.Module):
    """(B, 3, T, H, W) -> (B, codebook_dim, T/d, H/d, W/d)."""

    def __init__(self, cfg: VideoVQConfig):
        super().__init__()
        c = cfg.ch
        self.conv_in = conv3d(3, c, 3, padding=1)
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"res_{i}_{j}", ResBlock3D(c, cfg.ch * mult))
                c = cfg.ch * mult
            self.add_module(f"down_{i}", conv3d(c, c, 4, stride=2,
                                                padding=1))
        self.mid = ResBlock3D(c, c)
        self.norm_out = GroupNorm8(c)
        self.conv_out = conv3d(c, cfg.codebook_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the submodules were registered in the flax module's call order
        for module in self.children():
            x = module(x)
        return x


class VideoDecoder(nn.Module):
    """(B, codebook_dim, t, h, w) -> (B, 3, t*d, h*d, w*d)."""

    def __init__(self, cfg: VideoVQConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv3d(cfg.codebook_dim, c, 3, padding=1)
        self.mid = ResBlock3D(c, c)
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            self.add_module(f"up_{i}", conv3d(c, cfg.ch * mult, 3,
                                              padding=1))
            c = cfg.ch * mult
            for j in range(cfg.num_res_blocks):
                self.add_module(f"res_{i}_{j}", ResBlock3D(c, c))
        self.norm_out = GroupNorm8(c)
        self.conv_out = conv3d(c, 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for name, module in self.named_children():
            if name.startswith("up_"):
                # jax.image.resize "nearest" at exactly 2x on each axis
                z = F.interpolate(z, scale_factor=2, mode="nearest")
            z = module(z)
        return z


class VideoVQVAE(nn.Module):
    """encode: clips (B, T, H, W, 3) in [-1, 1] -> ids (B, T'*H'*W'),
    time-major; decode: ids -> clips. Weights are drawn from `generator`
    (seed 0 by default) with the flax init's distributions."""

    def __init__(self, cfg: VideoVQConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoEncoder(cfg)
        self.decoder = VideoDecoder(cfg)
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size,
                                                 cfg.codebook_dim))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal conv kernels, zero biases, GroupNorms 1 / 0, the
        codebook uniform in [0, 2/N) (torch and JAX draw different
        numbers)."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                _truncated_normal_(m.weight, (1.0 / m.weight[0].numel())
                                   ** 0.5 / .87962566103423978, generator)
                m.bias.zero_()
            elif isinstance(m, GroupNorm8):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.codebook.copy_(torch.rand(self.codebook.shape,
                                       generator=generator)
                            * (2.0 / self.cfg.codebook_size))

    def _codes(self) -> torch.Tensor:
        cb = self.codebook.float()
        if self.cfg.l2_norm_codes:
            cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return cb

    def latents(self, clips: torch.Tensor) -> torch.Tensor:
        """The encoder's latents (B, t, h, w, D) of clips (B, T, H, W, 3)."""
        z = self.encoder(clips.float().permute(0, 4, 1, 2, 3).contiguous())
        return z.permute(0, 2, 3, 4, 1)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest-codebook ids (...) of latents (..., D): argmin |z - c|^2
        = argmax z.c - |c|^2 / 2, one product."""
        cb = self._codes()
        z = z.float()
        if self.cfg.l2_norm_codes:
            z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        score = z @ cb.T - 0.5 * (cb * cb).sum(-1)
        return score.argmax(-1)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        check_ids(ids, self.cfg.codebook_size)
        return self._codes()[ids]

    def encode(self, clips: torch.Tensor) -> torch.Tensor:
        ids = self.quantize(self.latents(clips))
        return ids.reshape(ids.shape[0], -1)

    def decode(self, ids: torch.Tensor, t_grid: int, s_grid: int
               ) -> torch.Tensor:
        z = self.lookup(ids.long()).reshape(ids.shape[0], t_grid, s_grid,
                                            s_grid, self.cfg.codebook_dim)
        out = self.decoder(z.permute(0, 4, 1, 2, 3).contiguous())
        return out.permute(0, 2, 3, 4, 1)

    def forward(self, clips: torch.Tensor):
        """Encode and decode; returns (recon (B, T, H, W, 3), ids)."""
        ids = self.encode(clips)
        d = self.cfg.downsample
        return self.decode(ids, clips.shape[1] // d,
                           clips.shape[2] // d), ids


def video_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``VideoVQVAE`` params -> a state_dict for ``VideoVQVAE``."""
    return state_dict_from_jax(params)
