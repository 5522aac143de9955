"""LlamaGen-style VQGAN image tokenizer and the KL-VAE (port of
``unidisc_tpu/tokenizers/vqgan.py``).

The modules are ``nn.Module``s in PyTorch's NCHW layout; the codec API
keeps the JAX package's contract: ``VQGAN.encode`` takes images (B, H, W,
3) in [-1, 1] and returns ids (B, h*w), ``VQGAN.decode`` takes ids and
returns images (B, H, W, 3). Submodules carry the flax module names
(``down_{i}_block_{j}``, ``mid_attn_1``, ``up_{i}_upsample``...), so a
parameter's name is its flax path with ``/`` read as ``.``, ``kernel`` and
``scale`` read as ``weight``; ``state_dict_from_jax`` does that mapping.

Numerics follow the flax modules, in fp32:

  * GroupNorm: 32 groups, eps 1e-6, in fp32 (``F.group_norm``; flax takes
    the variance as E[x^2] - E[x]^2, torch as E[(x - E[x])^2], which moves
    an output by ~1e-6 of its scale at these widths);
  * Downsample pads (0, 1, 0, 1) and runs a stride-2 VALID 3x3 conv, as
    the torch checkpoints do; Upsample is nearest at exactly 2x;
  * AttnBlock is single-head attention over the h*w positions with an
    fp32 softmax, two ``bmm``s as the JAX module's two einsums;
  * ``quantize`` is argmax(2 z.c - |c|^2) over the whole codebook, both
    sides L2-normalised under ``l2_norm_codes``; argmax keeps the first
    index of a tie, as ``jnp.argmax`` does.

The published-checkpoint loaders (``load_torch_state_dict`` for LlamaGen's
naming, ``load_taming_torch_state_dict`` and ``load_klvae_torch_state_dict``
for CompVis's) rename a torch state_dict onto this module's names; they
check every name and shape, and refuse architecture weights they cannot
place.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class VQConfig:
    codebook_size: int = 16384
    codebook_dim: int = 256
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)  # VQ-16 (f=16)
    num_res_blocks: int = 2
    z_channels: int = 256
    dropout: float = 0.0
    l2_norm_codes: bool = True
    # levels (indices into ch_mult) with per-block spatial attention
    # (taming layout); LlamaGen's default has none
    attn_levels: Tuple[int, ...] = ()
    # MaskGIT's tokenizer: no bottleneck attention, no 1x1 quant convs
    mid_attn: bool = True
    use_quant_conv: bool = True

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


def vq8_config(**over) -> VQConfig:
    return VQConfig(ch_mult=(1, 2, 2, 4), **over)


def taming_config(**over) -> VQConfig:
    """Published taming-transformers VQGAN f16 layout (attention at the
    bottleneck level, raw codes)."""
    base = dict(ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                z_channels=256, codebook_size=16384, codebook_dim=256,
                l2_norm_codes=False, attn_levels=(4,))
    base.update(over)
    return VQConfig(**base)


def maskgit_config(**over) -> VQConfig:
    """MaskGIT-class f16 VQGAN: pure conv, 1024 raw codes of dim 256
    emitted directly by the encoder."""
    base = dict(ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                z_channels=256, codebook_size=1024, codebook_dim=256,
                l2_norm_codes=False, attn_levels=(), mid_attn=False,
                use_quant_conv=False)
    base.update(over)
    return VQConfig(**base)


def chameleon_config(**over) -> VQConfig:
    """Chameleon/Anole f16 image VQGAN: taming layout, 8192 codes."""
    base = dict(ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                z_channels=256, codebook_size=8192, codebook_dim=256,
                l2_norm_codes=False, attn_levels=(4,))
    base.update(over)
    return VQConfig(**base)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv(cin: int, cout: int, k: int, stride: int = 1,
         padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding)


class GroupNorm(nn.Module):
    """32-group GroupNorm, eps 1e-6, computed in fp32."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), 32, self.weight.float(),
                            self.bias.float(), 1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dropout: float = 0.0):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = conv(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q = conv(c, c, 1)
        self.k = conv(c, c, 1)
        self.v = conv(c, c, 1)
        self.proj_out = conv(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        q = self.q(y).reshape(b, c, h * w).transpose(1, 2)   # (b, hw, c)
        k = self.k(y).reshape(b, c, h * w)                   # (b, c, hw)
        v = self.v(y).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.bmm(q.float(), k.float()) * (c ** -0.5),
                             dim=-1)
        out = torch.bmm(attn.to(v.dtype), v)                 # (b, hw, c)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = conv(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the torch checkpoints pad asymmetrically before a VALID conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = conv(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    """(B, 3, H, W) -> (B, z_channels or codebook_dim, H/f, W/f)."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.ch
        self.conv_in = conv(3, c, 3, padding=1)
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(c, cfg.ch * mult, cfg.dropout))
                c = cfg.ch * mult
                if i in cfg.attn_levels:
                    self.add_module(f"down_{i}_attn_{j}", AttnBlock(c))
            if i != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(c))
        self.mid_block_1 = ResnetBlock(c, c, cfg.dropout)
        if cfg.mid_attn:
            self.mid_attn_1 = AttnBlock(c)
        self.mid_block_2 = ResnetBlock(c, c, cfg.dropout)
        self.norm_out = GroupNorm(c)
        out_ch = cfg.z_channels if cfg.use_quant_conv else cfg.codebook_dim
        self.conv_out = conv(c, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the submodules were registered in the flax module's call order
        for module in self.children():
            x = module(x)
            if module is self.norm_out:
                x = swish(x)
        return x


class Decoder(nn.Module):
    """(B, z_channels or codebook_dim, h, w) -> (B, 3, h*f, w*f)."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.ch * cfg.ch_mult[-1]
        in_ch = cfg.z_channels if cfg.use_quant_conv else cfg.codebook_dim
        self.conv_in = conv(in_ch, c, 3, padding=1)
        self.mid_block_1 = ResnetBlock(c, c, cfg.dropout)
        if cfg.mid_attn:
            self.mid_attn_1 = AttnBlock(c)
        self.mid_block_2 = ResnetBlock(c, c, cfg.dropout)
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(c, cfg.ch * mult, cfg.dropout))
                c = cfg.ch * mult
                if i in cfg.attn_levels:
                    self.add_module(f"up_{i}_attn_{j}", AttnBlock(c))
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(c))
        self.norm_out = GroupNorm(c)
        self.conv_out = conv(c, 3, 3, padding=1)

    forward = Encoder.forward


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """A normal of `std` truncated at two standard deviations, by
    rejection (a few times faster than ``nn.init.trunc_normal_``)."""
    t.normal_(generator=generator)
    bad = t.abs() > 2
    while bad.any():
        t[bad] = torch.randn(int(bad.sum()), generator=generator,
                             device=t.device)
        bad = t.abs() > 2
    t.mul_(std)


@torch.no_grad()
def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation, for every conv under `module`:
    truncated-normal kernels of variance 1/fan_in (lecun_normal), zero
    biases; GroupNorm weight 1, bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            _truncated_normal_(m.weight, math.sqrt(1.0 / fan_in)
                               / .87962566103423978, generator)
            m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class VQGAN(nn.Module):
    """encode: images (B, H, W, 3) in [-1, 1] -> ids (B, h*w); decode: ids
    -> images (B, H, W, 3). Weights are drawn from `generator` (seed 0 by
    default)."""

    def __init__(self, cfg: VQConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = conv(cfg.z_channels, cfg.codebook_dim, 1)
            self.post_quant_conv = conv(cfg.codebook_dim, cfg.z_channels, 1)
        else:
            # MaskGIT layout: the encoder emits code vectors directly
            self.quant_conv = nn.Identity()
            self.post_quant_conv = nn.Identity()
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size,
                                                 cfg.codebook_dim))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax init's distributions (torch and JAX draw different
        numbers): lecun_normal convs, codebook uniform in [0, 2/N)."""
        lecun_normal_(self, generator)
        self.codebook.copy_(torch.rand(self.codebook.shape,
                                       generator=generator)
                            * (2.0 / self.cfg.codebook_size))

    def _codes(self) -> torch.Tensor:
        cb = self.codebook.float()
        if self.cfg.l2_norm_codes:
            cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return cb

    def latents(self, images: torch.Tensor) -> torch.Tensor:
        """Pre-quantization latents (B, D, h, w) of images (B, H, W, 3)."""
        return self.quant_conv(self.encoder(nhwc_to_nchw(images.float())))

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest-codebook ids (B, h, w) of latents z (B, D, h, w)."""
        cb = self._codes()
        b, d, h, w = z.shape
        zf = nchw_to_nhwc(z.float()).reshape(-1, d)
        if self.cfg.l2_norm_codes:
            zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        # argmin |z - c|^2 = argmax (2 z.c - |c|^2); one product
        logits = 2.0 * (zf @ cb.T) - (cb ** 2).sum(-1)
        return logits.argmax(-1).reshape(b, h, w)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Code vectors (B, D, h, w) of ids (B, h, w)."""
        return self._codes()[ids].permute(0, 3, 1, 2)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        ids = self.quantize(self.latents(images))
        return ids.reshape(ids.shape[0], -1)

    def decode(self, ids: torch.Tensor, grid: Optional[int] = None
               ) -> torch.Tensor:
        grid = grid or math.isqrt(ids.shape[-1])
        zq = self.lookup(ids.reshape(ids.shape[0], grid, grid).long())
        return nchw_to_nhwc(self.decoder(self.post_quant_conv(zq)))

    def forward(self, images: torch.Tensor):
        """Autoencode round trip; returns (recon (B, H, W, 3), ids)."""
        z = self.latents(images)
        ids = self.quantize(z)
        zq = self.lookup(ids)
        # straight-through estimator for codec training
        zq = z + (zq - z).detach()
        recon = nchw_to_nhwc(self.decoder(self.post_quant_conv(zq)))
        return recon, ids.reshape(ids.shape[0], -1)


# ---------------------------------------------------------------------------
# KL-VAE (continuous latents: the sd-vae backend)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KLVAEConfig:
    """SD-VAE-class autoencoder: the encoder emits 2*z_channels moments
    (mean, logvar); latents are scaled by scale_factor."""
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)  # f=8
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    scale_factor: float = 0.18215
    dropout: float = 0.0

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


class KLVAE(nn.Module):
    """encode: images -> scaled latents (B, h*w, embed_dim); decode:
    latents -> images. The VQGAN's Encoder/Decoder stacks."""

    def __init__(self, cfg: KLVAEConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        trunk = dict(ch=c.ch, ch_mult=c.ch_mult,
                     num_res_blocks=c.num_res_blocks, dropout=c.dropout)
        self.encoder = Encoder(VQConfig(z_channels=2 * c.z_channels,
                                        **trunk))
        self.decoder = Decoder(VQConfig(z_channels=c.z_channels, **trunk))
        self.quant_conv = conv(2 * c.z_channels, 2 * c.embed_dim, 1)
        self.post_quant_conv = conv(c.embed_dim, c.z_channels, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self, generator)

    def moments(self, images: torch.Tensor):
        """(mean, logvar), each (B, h, w, embed_dim)."""
        h = nchw_to_nhwc(self.quant_conv(self.encoder(
            nhwc_to_nchw(images.float()))))
        mean, logvar = h.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def _sample(self, mean, logvar, rng, noise):
        """The posterior mean, or one reparameterized draw: `noise` given
        (a standard normal of mean's shape), else drawn from `rng`."""
        if noise is None and rng is None:
            return mean
        if noise is None:
            noise = torch.randn(mean.shape, generator=rng,
                                device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean)

    def encode(self, images: torch.Tensor,
               rng: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latents (B, h*w, embed_dim): the posterior mean without
        `rng` or `noise`, else one reparameterized sample."""
        mean, logvar = self.moments(images)
        z = self._sample(mean, logvar, rng, noise) * self.cfg.scale_factor
        b, hh, ww, c = z.shape
        return z.reshape(b, hh * ww, c)

    def decode(self, latents: torch.Tensor, grid: Optional[int] = None
               ) -> torch.Tensor:
        b = latents.shape[0]
        grid = grid or math.isqrt(latents.shape[1])
        z = latents.float().reshape(b, grid, grid, -1) / self.cfg.scale_factor
        return nchw_to_nhwc(self.decoder(self.post_quant_conv(
            nhwc_to_nchw(z))))

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None, *,
                noise: Optional[torch.Tensor] = None):
        """Autoencode round trip; returns (recon, mean, logvar)."""
        mean, logvar = self.moments(images)
        z = self._sample(mean, logvar, rng, noise)
        recon = self.decoder(self.post_quant_conv(nhwc_to_nchw(z)))
        return nchw_to_nhwc(recon), mean, logvar


# ---------------------------------------------------------------------------
# weights from the JAX package
# ---------------------------------------------------------------------------

def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax conv-codec parameter tree (numpy arrays) -> the port's
    state_dict: the path joined with ".", conv kernels HWIO -> OIHW (and
    DHWIO -> OIDHW) as ``weight``, GroupNorm ``scale`` -> ``weight``, every
    other leaf (biases, the codebook) as it is; fp32 tensors on the CPU."""
    sd = {}
    for path, arr in _flatten(params).items():
        arr = arr.astype(np.float32)
        if path[-1] == "kernel":     # (..., I, O) -> (O, I, ...)
            arr = np.transpose(arr, (arr.ndim - 1, arr.ndim - 2,
                                     *range(arr.ndim - 2)))
        leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1],
                                                           path[-1])
        sd[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd


def vqgan_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``VQGAN`` params -> a state_dict for the port's ``VQGAN``."""
    return state_dict_from_jax(params)


def klvae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``KLVAE`` params -> a state_dict for the port's ``KLVAE``."""
    return state_dict_from_jax(params)


# ---------------------------------------------------------------------------
# published torch checkpoints
# ---------------------------------------------------------------------------

# the state_dict roots that hold the autoencoder's weights: a checkpoint
# key under one of them must find a place in the module (taming
# checkpoints also carry their training loss, under "loss.")
_ARCH_ROOTS = ("encoder", "decoder", "quant_conv", "post_quant_conv")


def _renamed(model: nn.Module, state_dict: Mapping,
             source: Callable[[str], str],
             roots: Optional[Tuple[str, ...]] = _ARCH_ROOTS
             ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for `model`, each entry taken from
    ``state_dict[source(name)]``; every name and shape is checked, and an
    architecture weight of the checkpoint (a key under one of `roots`, or
    any key when `roots` is None) that no name takes raises."""
    out, used = {}, set()
    for name, ref in model.state_dict().items():
        key = source(name)
        if key not in state_dict:
            raise KeyError(f"{name}: the checkpoint has no {key}")
        val = state_dict[key]
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(np.asarray(val))
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{name} <- {key}: shape {tuple(val.shape)}, "
                             f"the module's {tuple(ref.shape)}")
        out[name] = val.to(ref.dtype)
        used.add(key)
    stray = sorted(k for k in state_dict if k not in used and (
        roots is None or k.split(".")[0] in roots))
    if stray:
        raise KeyError(f"checkpoint weights with no place in the module "
                       f"({len(stray)}): {stray[:8]}")
    return out


def _sub(rules, name: str) -> str:
    for pattern, repl in rules:
        name, n = re.subn(pattern, repl, name)
        if n:
            break
    return name


_MID = {"mid_block_1": "0", "mid_attn_1": "1", "mid_block_2": "2"}
_COMPVIS_MID = {"mid_block_1": "block_1", "mid_attn_1": "attn_1",
                "mid_block_2": "block_2"}


def load_torch_state_dict(model: VQGAN, state_dict: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """A LlamaGen VQModel state_dict (public tokenizer/tokenizer_image/
    vq_model.py naming: ``encoder.conv_blocks.{i}.res.{j}``,
    ``.downsample``, ``encoder.mid.{0,1,2}``, ``quantize.embedding.weight``,
    ``decoder.conv_blocks.{k}`` from the bottleneck up) -> the port's
    state_dict for `model`."""
    levels = len(model.cfg.ch_mult)

    def up(m):   # decoder blocks run from the bottleneck level down to 0
        return f"decoder.conv_blocks.{levels - 1 - int(m[1])}."

    rules = [
        (r"^(encoder|decoder)\.(mid_block_1|mid_attn_1|mid_block_2)\.",
         lambda m: f"{m[1]}.mid.{_MID[m[2]]}."),
        (r"^encoder\.down_(\d+)_block_(\d+)\.",
         r"encoder.conv_blocks.\1.res.\2."),
        (r"^encoder\.down_(\d+)_attn_(\d+)\.",
         r"encoder.conv_blocks.\1.attn.\2."),
        (r"^encoder\.down_(\d+)_downsample\.",
         r"encoder.conv_blocks.\1.downsample."),
        (r"^decoder\.up_(\d+)_block_(\d+)\.",
         lambda m: up(m) + f"res.{m[2]}."),
        (r"^decoder\.up_(\d+)_attn_(\d+)\.",
         lambda m: up(m) + f"attn.{m[2]}."),
        (r"^decoder\.up_(\d+)_upsample\.",
         lambda m: up(m) + "upsample."),
        (r"^codebook$", "quantize.embedding.weight"),
    ]
    return _renamed(model, state_dict, lambda n: _sub(rules, n))


_COMPVIS_RULES = [
    (r"^(encoder|decoder)\.(mid_block_1|mid_attn_1|mid_block_2)\.",
     lambda m: f"{m[1]}.mid.{_COMPVIS_MID[m[2]]}."),
    # taming's decoder up.{i} is indexed by resolution level, as here
    (r"^encoder\.down_(\d+)_block_(\d+)\.", r"encoder.down.\1.block.\2."),
    (r"^encoder\.down_(\d+)_attn_(\d+)\.", r"encoder.down.\1.attn.\2."),
    (r"^encoder\.down_(\d+)_downsample\.", r"encoder.down.\1.downsample."),
    (r"^decoder\.up_(\d+)_block_(\d+)\.", r"decoder.up.\1.block.\2."),
    (r"^decoder\.up_(\d+)_attn_(\d+)\.", r"decoder.up.\1.attn.\2."),
    (r"^decoder\.up_(\d+)_upsample\.", r"decoder.up.\1.upsample."),
    (r"^codebook$", "quantize.embedding.weight"),
]


def _compvis_name(name: str) -> str:
    """Port name -> the CompVis/taming autoencoder name (the published
    taming VQModel and SD ``first_stage_model`` share it)."""
    return _sub(_COMPVIS_RULES, name)


def load_taming_torch_state_dict(model: VQGAN, state_dict: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """A taming-transformers VQModel state_dict (vqgan_imagenet_f16_*
    naming, intra-level attention, ``quantize.embedding.weight``) -> the
    port's state_dict for a `model` built from ``taming_config()``."""
    return _renamed(model, state_dict, _compvis_name)


def load_klvae_torch_state_dict(model: KLVAE, state_dict: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """A CompVis KL autoencoder state_dict (SD ``first_stage_model``
    naming) -> the port's state_dict for `model`."""
    return _renamed(model, state_dict, _compvis_name)
