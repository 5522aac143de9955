"""Image codec factory: one API over the tokenizer backends (port of
``unidisc_tpu/tokenizers/image_codecs.py``).

A codec holds its module (the weights) and its device. ``encode(images)``
takes images (B, H, W, 3) in [-1, 1] and returns ids (B, T) (int64);
``decode(ids)`` returns images (B, H, W, 3) (fp32); both take tensors (or
arrays) and return tensors on the codec's device, as the JAX codecs take
and return arrays.

Backends: LlamaGen VQ-16 / VQ-8, taming, MaskGIT-class and Chameleon
VQGANs (``tokenizers/vqgan.py``), MAGVITv2 (the Show-o codec,
``tokenizers/magvit.py``), TiTok 1D (``tokenizers/titok.py``), LFQ, BSQ and
Cosmos-style FSQ on a shared 16x conv trunk, raw pixels, the deterministic
dummy codec, the SD KL-VAE continuous codec (``get_continuous_codec``) and
the video VQVAE (``get_video_codec``, ``tokenizers/video.py``). The
factories build on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.tokenizers.vqgan import (KLVAE, VQGAN, KLVAEConfig,
                                                VQConfig, chameleon_config,
                                                lecun_normal_,
                                                load_torch_state_dict,
                                                maskgit_config,
                                                nchw_to_nhwc, nhwc_to_nchw,
                                                taming_config, vq8_config)


@dataclass
class ImageCodec:
    """A discrete image codec on one device."""
    name: str
    module: Optional[nn.Module]     # the weights; None for pixels, dummy
    encode_fn: Callable             # images (B, H, W, 3) -> ids (B, T)
    decode_fn: Callable             # ids (B, T) -> images (B, H, W, 3)
    vocab_size: int
    downsample: int                 # tokens per side = H // downsample
    image_size: int
    device: torch.device

    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device, torch.float32)
        return self.encode_fn(images).long()

    @torch.no_grad()
    def decode(self, ids) -> torch.Tensor:
        return self.decode_fn(torch.as_tensor(ids).to(self.device,
                                                       torch.long))

    def to(self, device) -> "ImageCodec":
        self.device = resolve_device(device)
        if self.module is not None:
            self.module.to(self.device)
        return self


@dataclass
class ContinuousCodec:
    """A continuous-latent codec (the sd-vae backend): encode returns float
    latents (B, T, latent_dim) instead of ids."""
    name: str
    module: KLVAE
    latent_dim: int
    downsample: int
    image_size: int
    device: torch.device

    @torch.no_grad()
    def encode(self, images, rng: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device, torch.float32)
        return self.module.encode(images, rng)

    @torch.no_grad()
    def decode(self, latents) -> torch.Tensor:
        latents = torch.as_tensor(latents).to(self.device, torch.float32)
        return self.module.decode(latents,
                                  self.image_size // self.downsample)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# VQGANs
# ---------------------------------------------------------------------------

# (names, config preset, the codec's name)
_VQ_PRESETS = (
    (("llamagen-vq16", "vq16", "llamagen"), VQConfig, "llamagen-vq16"),
    (("llamagen-vq8", "vq8"), vq8_config, "llamagen-vq8"),
    # published taming checkpoints load via load_taming_torch_state_dict
    (("taming",), taming_config, "taming"),
    (("maskgit-vqgan", "maskgit"), maskgit_config, "maskgit-vqgan"),
    # the VQ stage under the chameleon/anole/lumina stream tokenizers
    (("chameleon-vqgan", "anole", "lumina"), chameleon_config,
     "chameleon-vqgan"),
)


def _vq_preset(name: str):
    for names, preset, canonical in _VQ_PRESETS:
        if name in names:
            return preset, canonical
    return None


def _make_vqgan(cfg: VQConfig, generator, image_size: int, name: str,
                device) -> ImageCodec:
    model = VQGAN(cfg, generator).eval()
    grid = image_size // cfg.downsample
    return ImageCodec(name=name, module=model, encode_fn=model.encode,
                      decode_fn=lambda ids: model.decode(ids, grid),
                      vocab_size=cfg.codebook_size,
                      downsample=cfg.downsample, image_size=image_size,
                      device=torch.device("cpu")).to(device)


# ---------------------------------------------------------------------------
# LFQ / BSQ / FSQ on a shared conv trunk
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class TrunkEncoder(nn.Module):
    """Four 4x4 stride-2 convs with GELU, then a 1x1 conv to the latent."""

    def __init__(self, latent_dim: int, ch: int = 64):
        super().__init__()
        c = 3
        for i, mult in enumerate([1, 2, 4, 4]):
            self.add_module(f"down_{i}", nn.Conv2d(c, ch * mult, 4,
                                                   stride=2, padding=1))
            c = ch * mult
        self.to_bits = nn.Conv2d(c, latent_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = gelu(getattr(self, f"down_{i}")(x))
        return self.to_bits(x)


class TrunkDecoder(nn.Module):
    """A 1x1 conv from the latent, four nearest-2x + 3x3 conv + GELU
    stages, then a 3x3 conv to RGB."""

    def __init__(self, latent_dim: int, ch: int = 64):
        super().__init__()
        self.from_bits = nn.Conv2d(latent_dim, ch * 4, 1)
        c = ch * 4
        for i, mult in enumerate([4, 4, 2, 1]):
            self.add_module(f"up_{i}", nn.Conv2d(c, ch * mult, 3, padding=1))
            c = ch * mult
        self.to_rgb = nn.Conv2d(c, 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.from_bits(z)
        for i in range(4):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = gelu(getattr(self, f"up_{i}")(h))
        return self.to_rgb(h)


class ConvTrunk(nn.Module):
    """The encoder/decoder pair of the sign/level quantizer codecs; the
    codecs differ only in how the (B, g, g, latent_dim) latent becomes
    ids."""

    def __init__(self, latent_dim: int, ch: int = 64):
        super().__init__()
        self.enc = TrunkEncoder(latent_dim, ch)
        self.dec = TrunkDecoder(latent_dim, ch)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return nchw_to_nhwc(self.enc(nhwc_to_nchw(images)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return nchw_to_nhwc(self.dec(nhwc_to_nchw(z)))


def _trunk(latent_dim: int, ch: int, generator) -> ConvTrunk:
    trunk = ConvTrunk(latent_dim, ch)
    lecun_normal_(trunk, generator)
    return trunk.eval()


def _grid_of(ids: torch.Tensor) -> int:
    return math.isqrt(ids.shape[-1])


def _sign_codec(name: str, generator, image_size: int, bits: int, ch: int,
                corner: float, device) -> ImageCodec:
    """LFQ (corner 1) and BSQ (corner 1/sqrt(bits)): the latent's sign
    pattern is the id; the decoder reads the +-corner vector."""
    trunk = _trunk(bits, ch, generator)

    def weights(x):
        return 2 ** torch.arange(bits, device=x.device)

    def encode(images):
        z = trunk.encode(images)
        ids = ((z > 0).long() * weights(z)).sum(-1)
        return ids.reshape(ids.shape[0], -1)

    def decode(ids):
        g = _grid_of(ids)
        bitsarr = ((ids[..., None] // weights(ids)) % 2).float()
        z = ((2.0 * bitsarr - 1.0) * corner).reshape(ids.shape[0], g, g,
                                                     bits)
        return trunk.decode(z)

    return ImageCodec(name=name, module=trunk, encode_fn=encode,
                      decode_fn=decode, vocab_size=2 ** bits, downsample=16,
                      image_size=image_size,
                      device=torch.device("cpu")).to(device)


def _make_lfq(generator, image_size: int, device, bits: int = 14,
              ch: int = 64) -> ImageCodec:
    """Lookup-free quantization: the sign pattern is the id; codebook
    2^bits."""
    return _sign_codec("lfq", generator, image_size, bits, ch, 1.0, device)


def _make_bsq(generator, image_size: int, device, bits: int = 18,
              ch: int = 64) -> ImageCodec:
    """Binary spherical quantization: the id is the sign pattern, the code
    vector the unit-norm corner sign/sqrt(bits)."""
    return _sign_codec("bsq", generator, image_size, bits, ch,
                       1.0 / math.sqrt(bits), device)


def _make_fsq(generator, image_size: int, device,
              levels: tuple = (8, 8, 8, 5, 5, 5),
              ch: int = 64) -> ImageCodec:
    """Finite scalar quantization: each channel bounded by tanh to
    [-(L-1)/2, (L-1)/2], rounded to an integer level; the digits form one
    mixed-radix id."""
    levels = tuple(int(l) for l in levels)
    dim = len(levels)
    trunk = _trunk(dim, ch, generator)
    lv = torch.tensor(levels, dtype=torch.float32)
    half = (lv - 1.0) / 2.0
    place = torch.from_numpy(np.concatenate(
        [[1], np.cumprod(levels[:-1])]).astype(np.int64))
    top = torch.tensor(levels, dtype=torch.int64) - 1

    def encode(images):
        z = trunk.encode(images)
        h = half.to(z.device)
        digits = torch.round(torch.tanh(z) * h + h).long()
        digits = torch.minimum(digits.clamp_min(0), top.to(z.device))
        ids = (digits * place.to(z.device)).sum(-1)
        return ids.reshape(ids.shape[0], -1)

    def decode(ids):
        g = _grid_of(ids)
        h = half.to(ids.device)
        digits = (ids[..., None] // place.to(ids.device)) % (
            top.to(ids.device) + 1)
        z = (digits.float() - h) / h
        return trunk.decode(z.reshape(ids.shape[0], g, g, dim))

    return ImageCodec(name="cosmos-fsq", module=trunk, encode_fn=encode,
                      decode_fn=decode, vocab_size=int(np.prod(levels)),
                      downsample=16, image_size=image_size,
                      device=torch.device("cpu")).to(device)


# ---------------------------------------------------------------------------
# raw pixels and the dummy codec
# ---------------------------------------------------------------------------

def _make_pixels(image_size: int, device, pixel_grid: int = 16
                 ) -> ImageCodec:
    """Average-pool to a grid and quantize each colour to 3 bits: one id
    of 512 per cell."""
    down = image_size // pixel_grid

    def encode(images):
        b = images.shape[0]
        x = images.reshape(b, pixel_grid, down, pixel_grid, down, 3)
        x = x.mean(dim=(2, 4))
        q = ((x + 1) / 2 * 7.999).to(torch.int32).clamp(0, 7).long()
        ids = q[..., 0] * 64 + q[..., 1] * 8 + q[..., 2]
        return ids.reshape(b, -1)

    def decode(ids):
        b, g = ids.shape[0], _grid_of(ids)
        r, rem = ids // 64, ids % 64
        rgb = torch.stack([r, rem // 8, rem % 8], dim=-1)
        x = (rgb.float() / 7.0) * 2 - 1
        x = x.reshape(b, g, g, 1, 1, 3).expand(b, g, g, down, down, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * down, g * down, 3)

    return ImageCodec(name="pixels", module=None, encode_fn=encode,
                      decode_fn=decode, vocab_size=512, downsample=down,
                      image_size=image_size, device=resolve_device(device))


def _make_dummy(image_size: int, device, vocab: int = 16384) -> ImageCodec:
    """Deterministic hash codec for tests."""
    down = 16

    def encode(images):
        b, g = images.shape[0], image_size // down
        x = images.reshape(b, g, down, g, down, 3).mean(dim=(2, 4)).sum(-1)
        return ((x * 1e4).abs().to(torch.int32) % vocab).reshape(b, -1)

    def decode(ids):
        b, g = ids.shape[0], _grid_of(ids)
        x = (ids.float() / vocab) * 2 - 1
        x = x.reshape(b, g, g, 1).repeat_interleave(down, 1) \
            .repeat_interleave(down, 2)
        return x.expand(b, g * down, g * down, 3)

    return ImageCodec(name="dummy", module=None, encode_fn=encode,
                      decode_fn=decode, vocab_size=vocab, downsample=down,
                      image_size=image_size, device=resolve_device(device))


# ---------------------------------------------------------------------------
# MAGVITv2 (Show-o), TiTok and the video VQVAE
# ---------------------------------------------------------------------------

_MAGVIT_NAMES = ("showo", "show-o", "magvit", "magvitv2")


def _make_magvit(generator, image_size: int, device, **kw) -> ImageCodec:
    """MAGVITv2 LFQ conv tokenizer (showlab/magvitv2, the small-scale
    configs' codec)."""
    from unidisc_tpu_torch.tokenizers.magvit import MagvitConfig, MagvitLFQ
    cfg = MagvitConfig(**kw)
    model = MagvitLFQ(cfg, generator).eval()
    return ImageCodec(name="magvitv2", module=model, encode_fn=model.encode,
                      decode_fn=model.decode, vocab_size=cfg.codebook_size,
                      downsample=cfg.downsample, image_size=image_size,
                      device=torch.device("cpu")).to(device)


def _titok_downsample(cfg) -> int:
    """TiTok's ids are a 1D sequence of K tokens: the downsample reported
    is image_size / sqrt(K), layout bookkeeping only."""
    return max(1, int(cfg.image_size / math.sqrt(cfg.num_latent_tokens)))


def _make_titok(name: str, generator, image_size: int, device,
                **kw) -> ImageCodec:
    """TiTok 1D tokenizer (titok64 / titok128 / titok256)."""
    from unidisc_tpu_torch.tokenizers.titok import TiTok, titok_preset
    cfg = titok_preset(name, image_size=image_size, **kw)
    model = TiTok(cfg, generator).eval()
    return ImageCodec(name=name, module=model, encode_fn=model.encode,
                      decode_fn=model.decode, vocab_size=cfg.codebook_size,
                      downsample=_titok_downsample(cfg),
                      image_size=image_size,
                      device=torch.device("cpu")).to(device)


@dataclass
class VideoCodec:
    """A video codec on one device: ``encode(clips)`` takes clips (B, T,
    H, W, 3) in [-1, 1] and returns time-major ids (B, T'*H'*W') (int64);
    ``decode(ids)`` returns clips (fp32)."""
    name: str
    module: nn.Module
    vocab_size: int
    downsample: int                 # spatial AND temporal factor
    frames: int
    image_size: int
    device: torch.device

    @torch.no_grad()
    def encode(self, clips) -> torch.Tensor:
        clips = torch.as_tensor(clips).to(self.device, torch.float32)
        return self.module.encode(clips)

    @torch.no_grad()
    def decode(self, ids) -> torch.Tensor:
        d = self.downsample
        return self.module.decode(
            torch.as_tensor(ids).to(self.device, torch.long),
            self.frames // d, self.image_size // d)

    def to(self, device) -> "VideoCodec":
        self.device = resolve_device(device)
        self.module.to(self.device)
        return self


def get_video_codec(name: str = "video-vqvae", *,
                    generator: Optional[torch.Generator] = None,
                    frames: int = 16, image_size: int = 64, device="cuda",
                    **kw) -> VideoCodec:
    """The VideoGPT-style 3D-conv VQVAE (``tokenizers/video.py``) for
    clips of `frames` x `image_size`^2."""
    from unidisc_tpu_torch.tokenizers.video import VideoVQConfig, VideoVQVAE
    if name not in ("video-vqvae", "video"):
        raise ValueError(f"unknown video codec {name!r}")
    device = resolve_device(device)
    cfg = VideoVQConfig(**kw)
    model = VideoVQVAE(cfg, generator).eval()
    return VideoCodec(name="video-vqvae", module=model,
                      vocab_size=cfg.codebook_size,
                      downsample=cfg.downsample, frames=frames,
                      image_size=image_size,
                      device=torch.device("cpu")).to(device)


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

_TRUNK_CODECS = {"lfq": _make_lfq, "bsq": _make_bsq, "bsq18": _make_bsq,
                 "cosmos": _make_fsq, "cosmos-fsq": _make_fsq,
                 "fsq": _make_fsq}


def _refuse(name: str):
    """The error for a name the factory does not build."""
    if name in ("sd-vae", "klvae"):
        return ValueError(
            "sd-vae is a CONTINUOUS codec (float latents, no token ids): "
            "use get_continuous_codec('sd-vae')")
    if name in ("video-vqvae", "video"):
        return ValueError(
            "video-vqvae takes clips (B, T, H, W, 3), not images: use "
            "get_video_codec('video-vqvae')")
    if name == "chameleon":
        return ValueError(
            "'chameleon' names the STREAM tokenizer (var-aspect crops, "
            "grid/newline tokens): build a ChameleonSpec over an image "
            "codec (tokenizers/chameleon.py), e.g. "
            "get_codec('chameleon-vqgan') for its VQ stage")
    return ValueError(f"unknown codec {name!r}")


def codec_downsample(name: str, image_size: int = 256, **kw) -> int:
    """The downsample factor of codec `name`, without building its
    weights."""
    preset = _vq_preset(name)
    if preset is not None:
        return preset[0](**kw).downsample
    if name in _MAGVIT_NAMES:
        from unidisc_tpu_torch.tokenizers.magvit import MagvitConfig
        return MagvitConfig(**kw).downsample
    if name.startswith("titok"):
        from unidisc_tpu_torch.tokenizers.titok import titok_preset
        return _titok_downsample(titok_preset(name, image_size, **kw))
    if name == "pixels":
        return image_size // kw.get("pixel_grid", 16)
    if name in _TRUNK_CODECS or name == "dummy":
        return 16
    raise _refuse(name)


def get_codec(name: str, *, generator: Optional[torch.Generator] = None,
              image_size: int = 256, device="cuda", **kw) -> ImageCodec:
    """Codec factory; weights are drawn from `generator` (seed 0 by
    default) on the CPU and then moved to `device`."""
    device = resolve_device(device)
    preset = _vq_preset(name)
    if preset is not None:
        make, canonical = preset
        return _make_vqgan(make(**kw), generator, image_size, canonical,
                           device)
    if name in _MAGVIT_NAMES:
        return _make_magvit(generator, image_size, device, **kw)
    if name.startswith("titok"):
        return _make_titok(name, generator, image_size, device, **kw)
    if name in _TRUNK_CODECS:
        return _TRUNK_CODECS[name](_generator(generator), image_size,
                                   device, **kw)
    if name == "pixels":
        return _make_pixels(image_size, device, **kw)
    if name == "dummy":
        return _make_dummy(image_size, device, **kw)
    raise _refuse(name)


def get_continuous_codec(name: str = "sd-vae", *,
                         generator: Optional[torch.Generator] = None,
                         image_size: int = 256, device="cuda",
                         **kw) -> ContinuousCodec:
    """The KL-VAE continuous codec; published SD first_stage checkpoints
    load via ``vqgan.load_klvae_torch_state_dict``."""
    if name not in ("sd-vae", "klvae"):
        raise ValueError(f"unknown continuous codec {name!r}")
    cfg = KLVAEConfig(**kw)
    model = KLVAE(cfg, generator).to(resolve_device(device)).eval()
    return ContinuousCodec(name="sd-vae", module=model,
                           latent_dim=cfg.embed_dim,
                           downsample=cfg.downsample, image_size=image_size,
                           device=resolve_device(device))


def load_vqgan_torch_checkpoint(codec: ImageCodec, path: str) -> ImageCodec:
    """Load a published LlamaGen torch checkpoint (e.g. vq_ds16_c2i.pt)
    into a llamagen codec, in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model", ckpt.get("state_dict", ckpt))
    codec.module.load_state_dict(load_torch_state_dict(codec.module,
                                                       state_dict))
    return codec
